"""Launch: the D-PSGD training step (``train``) over a mesh (``mesh``: a
description for one card, or a ``DeviceMesh`` across ranks) and a
fabric's designed W (``fabric``), the partition specs (``sharding``), and
serving (``serve``). Tensor parallelism inside an agent waits in ROADMAP
item A7b."""
