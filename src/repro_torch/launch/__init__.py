"""Launch: the D-PSGD training step (``train``) over a mesh (``mesh``: a
description for one card, or a ``DeviceMesh`` across ranks) and a
fabric's designed W (``fabric``), the partition specs (``sharding``), and
serving (``serve``), with tensor parallelism over "model" inside an
agent, and FSDP and expert parallelism over "data" (the ``pod`` layout,
serving's 2-D tensor parallelism)."""
