"""Sharding and cost models (counterpart of ``repro.parallel``).

``sharding`` (the partition-spec rules for params, optimizer state,
batches and decode caches, and their placement as DTensors on a device
mesh), ``ctx`` (the layout hooks in the model code, and the replicated
constants an op on DTensors needs), ``compress`` (int8 gradient
compression and the cross-pod mean); ``roofline`` (the ``Roofline``
record and the card's rates) and ``memmodel`` (a block's footprint on
Hopper), which ``kernels.autotune`` scores geometries with. The meshes
themselves come from ``launch.mesh``.
"""
