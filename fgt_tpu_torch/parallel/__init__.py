"""Multi-GPU FGT: the (dp, tp, sp) process grid (:mod:`.mesh`), the
collectives the JAX package's partitioner inserts (:mod:`.collectives`)
and the Megatron tensor-parallel rules (:mod:`.partition`)."""
