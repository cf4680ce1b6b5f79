"""The work of one decode420 launch, whatever implements it.

Inputs: the batch that decode_entropy hands the device, ((shape, itemsize)
of luma, Cb, Cr coefficients (B, bh, bw, 64) and the luma and chroma
quantization tables (B, 64)). The work reads each coefficient and table
once and writes the decoded B, G and R u8 planes of the chroma grid's
extent (16 cbh x 16 cbw per image) once, and transforms every 8x8 block
by the separable 8-point IDCT, 2,048 FLOP a block (two passes of 8 rows
of 8 outputs of 8 multiply-adds). The least time is the larger of the
bytes over the memory bandwidth and the FLOP over the f32 peak.
"""

from math import prod


def work(shapes):
    """(bytes, flop) of one launch."""
    (y, ysz), (cb, csz), (cr, _), (qy, qsz), (qc, _) = shapes[:5]
    b, cbh, cbw = cb[0], cb[1], cb[2]
    nbytes = (prod(y) * ysz + (prod(cb) + prod(cr)) * csz
              + (prod(qy) + prod(qc)) * qsz + 3 * b * 16 * cbh * 16 * cbw)
    blocks = prod(y[:3]) + prod(cb[:3]) + prod(cr[:3])
    return nbytes, 2048 * blocks


def least_seconds(shapes, peaks):
    """(seconds, "bytes" or "flop") at the peaks' hbm_bytes_per_s and
    f32_flop_per_s."""
    nbytes, flop = work(shapes)
    tb, tf = nbytes / peaks["hbm_bytes_per_s"], flop / peaks["f32_flop_per_s"]
    return (tb, "bytes") if tb >= tf else (tf, "flop")
