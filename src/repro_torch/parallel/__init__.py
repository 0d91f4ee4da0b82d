"""Cost models of the port's kernels on the card.

Counterpart of ``repro.parallel``, so far in part: ``roofline`` (the
``Roofline`` record and the card's rates) and ``memmodel`` (a block's
footprint on Hopper), which ``kernels.autotune`` scores geometries with.
"""
