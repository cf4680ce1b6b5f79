"""png_fast_zlib_share (%): of the window's PNG inflates and deflates
(counts png_inflate_fast, png_inflate_zlib, png_deflate_fast and
png_deflate_zlib of the program's "decode" and "encode" spans), the
share libdeflate ran rather than Python's zlib."""

from portbench.png_counts import fast_zlib_share


def read(ctx):
    return fast_zlib_share(ctx)
