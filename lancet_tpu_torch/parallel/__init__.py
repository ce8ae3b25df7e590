"""Scaling past one device: a mesh of devices in one process (window-axis
and pair-axis data parallelism, `mesh`) and a fan-out over processes that
gathers the per-shard variant DBs (`multihost`)."""
