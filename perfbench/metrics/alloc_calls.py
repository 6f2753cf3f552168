"""Device (the caching allocator): calls into the device's allocator a
solve over the traced window, ``num_device_alloc + num_device_free`` of
``torch.cuda.memory_stats()``, read at the window's start and end, over the
solves. None off the card."""


def read(ctx):
    alloc, solves = ctx.run.get("alloc"), ctx.run["solves"]
    if not alloc or not solves:
        return None
    return alloc["device_calls"] / len(solves)
