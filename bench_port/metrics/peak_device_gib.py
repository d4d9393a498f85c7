"""torch.cuda.max_memory_allocated over the window (reset after warm-up)."""


def read(ctx):
    return ctx['peak_bytes'] / 2 ** 30 if ctx['peak_bytes'] else None
