"""Multi-GPU: the ``data x model`` process grid, its collectives and the
sharding rules (port of ``opadpo_tpu/parallel``)."""
