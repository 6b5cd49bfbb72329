"""The allocator's peak of reserved memory over the window
(``max_memory_reserved`` after ``reset_peak_memory_stats`` at the window's
start), GiB: a CUDA graph's replay allocates nothing, its pool is
reserved, so ``max_memory_allocated`` would miss it.  The reserved peak
also holds what the cache kept from the set-up."""


def read(run):
    return run.window_peak_bytes / 2 ** 30 if run.window_peak_bytes else None
