"""The PNG codec's stage counts on the still serving front's spans.

The program's PNG codec counts, inside the decode and encode workers'
calls, its stages' thread-CPU time and its zlib routes, and the front
adds them to each batch's ``decode`` and ``encode`` spans
(``png_inflate_cpu_ns``, ``png_inflate_fast``, ...). The readers of the
PNG per-layer metrics take them over the window's batches
(``spans.window_batches``); a count that a batch's span lacks (a program
that does not count it) reads nothing.
"""

from __future__ import annotations

from typing import Optional, Sequence

from portbench.spans import total, window_batches


def _counted(ctx, span: str, names: Sequence[str]):
    batches = window_batches(ctx)
    if batches is None or any(k not in b[span].counts
                              for b in batches for k in names):
        return None
    return batches


def cpu_ms_per_image(ctx, span: str, names: Sequence[str]
                     ) -> Optional[float]:
    """The summed thread-CPU ns of the counts `names` on the window's
    `span` spans, in ms, over the images those spans served."""
    batches = _counted(ctx, span, names)
    if batches is None:
        return None
    images = total(batches, span, "images")
    ns = sum(total(batches, span, k) for k in names)
    return ns / 1e6 / images if images else None


ROUTES = (("decode", "png_inflate_fast", "png_inflate_zlib"),
          ("encode", "png_deflate_fast", "png_deflate_zlib"))


def fast_zlib_share(ctx) -> Optional[float]:
    """The share (%) of the window's inflates and deflates that
    libdeflate ran, of all the images inflated or deflated."""
    fast = every = 0.0
    for span, f, z in ROUTES:
        batches = _counted(ctx, span, (f, z))
        if batches is None:
            return None
        fast += total(batches, span, f)
        every += total(batches, span, f) + total(batches, span, z)
    return 100.0 * fast / every if every else None
