"""host_encode_ms_per_image (ms): host-clock time in the pipeline's
encode_entropy (the host Huffman encode of a batch) over the images it
encoded, in the traced window."""


def read(ctx):
    ms = ctx.spans.get("encode_entropy")
    if not ms:
        return None
    return sum(ms) / (len(ms) * len(ctx.window.slot_source))
