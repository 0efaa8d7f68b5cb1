"""The distribution substrate of the port (``repro.dist`` on
``torch.distributed``): what the model and launch layers need to run the
same program on one device or over a ("pod", "data", "model") mesh.

  compat       DTensor imports across torch releases, the start of a
               process group for a mesh, and the host-staged group that
               lets two ranks share one card
  constrain    the ambient mesh (``use_mesh``) and the sharding
               constraints that do nothing without one
  sharding     PartitionSpecs for params / caches / inputs, their DTensor
               placements (``NamedSharding``), and the fleet's rung shards
  local_ops    local forms, with their collectives spelled out, of ops
               whose DTensor rules fail (attention core, vocab-parallel
               embedding)
  collectives  compressed (int8 + error feedback) gradient all-reduce
  pipeline     GPipe-style microbatch pipelining over a mesh axis
  moe_ep       expert-parallel capacity routing for MoE layers
  fault        straggler telemetry, checkpoint / restart supervision and
               the fleet's host supervisor
"""
