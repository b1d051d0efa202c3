"""Terminal progress bar of a render: `render` without `--no-progress`.

Counterpart of `raytracing_rust_tpu/utils/progress.py`. The reference's
bar (src/progressbar.rs) is a simulation that no caller runs; this one is
called by the render itself, `progress(done, total)` once per unit of work
done (`ops/tracer.render_kernel`: a sample chunk; `render.render`: a pixel
block's sample chunk; `parallel/sharding.render_sharded`: rank 0's).
"""

from __future__ import annotations

import shutil
import sys
import time


class ProgressBar:
    def __init__(self, desc: str = "render", stream=None):
        self.desc = desc
        self.stream = stream or sys.stderr
        self.start = time.monotonic()

    def __call__(self, done: int, total: int) -> None:
        """Redraw the bar at done of total: the bar, the percentage and the
        time left at the rate so far; a newline once done reaches total."""
        width = shutil.get_terminal_size((80, 20)).columns
        bar_w = max(10, width - len(self.desc) - 30)
        frac = done / max(total, 1)
        filled = int(bar_w * frac)
        elapsed = time.monotonic() - self.start
        eta = elapsed / frac - elapsed if frac > 0 else 0.0
        self.stream.write(
            f"\r{self.desc} |{'█' * filled}{' ' * (bar_w - filled)}| "
            f"{100 * frac:5.1f}% eta {eta:6.1f}s")
        if done >= total:
            self.stream.write("\n")
        self.stream.flush()
