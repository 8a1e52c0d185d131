"""Multi-GPU serving: the (dp, tp) mesh and its placement (``sharding``) and the
collectives between tensor-parallel ranks (``collectives``)."""
