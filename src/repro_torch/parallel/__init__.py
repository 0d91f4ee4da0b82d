"""Sharding and cost models (counterpart of ``repro.parallel``).

``sharding`` (the partition-spec rules for params, optimizer state,
batches and decode caches, and their placement as DTensors on a device
mesh), ``ctx`` (the layout hooks in the model code, and the replicated
constants an op on DTensors needs), ``compress`` (int8 gradient
compression and the cross-pod mean); ``roofline`` (the ``Roofline``
record, the card's rates and the count of a step traced on ``meta``
tensors) and ``memmodel`` (a block's footprint on Hopper, and the
analytic HBM model of a cell), which ``kernels.autotune`` and the
dry-run (``launch.dryrun``) use. The meshes themselves come from
``launch.mesh``.
"""
