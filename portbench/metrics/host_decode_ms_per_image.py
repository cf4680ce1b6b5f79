"""host_decode_ms_per_image (ms): host-clock time in the pipeline's
decode_entropy (the host entropy decode of a batch) over the images it
decoded, in the traced window."""


def read(ctx):
    ms = ctx.spans.get("decode_entropy")
    if not ms:
        return None
    return sum(ms) / (len(ms) * len(ctx.window.slot_source))
