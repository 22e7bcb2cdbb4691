"""The multi-device layer: the ranks' launcher, the tensor-parallel rules and
layers, and the parallel trainer."""
