"""Multi-GPU: the (dp, tp, sp) mesh on ``torch.distributed``, one process
per rank (the JAX package's parallel/).

  * ``distributed``: process-group bring-up from torchrun's environment
    and the backend of the layout (NCCL, or gloo where ranks share a
    card or run on the CPU);
  * ``sharding``: the registry of roles, specs and wire dtypes, the
    shard and gather of params and batches, ``analytic_comms``;
  * ``collectives``: the one module that calls ``torch.distributed``:
    the Megatron autograd collectives, staging, byte counters;
  * ``mesh``: ``MeshPlan``, ``make_mesh`` and the sharded train, eval
    and beam-search steps;
  * ``ring_attention``: ring and Ulysses sequence-parallel attention.
"""
