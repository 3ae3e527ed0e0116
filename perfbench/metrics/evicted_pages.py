"""evicted_pages: prefix-cached pages the pool evicted (its LRU of
refcount-0 registered pages, taken when the free list is dry) over the
whole window."""


def read(run):
    return run.counts.get("evicted_pages")
