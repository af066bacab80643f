"""Launch: the D-PSGD training step (``train``) over a mesh (``mesh``: a
description for one card, or a ``DeviceMesh`` across ranks) and a
fabric's designed W (``fabric``), the partition specs (``sharding``), and
serving (``serve``), with tensor parallelism over "model" inside an
agent. FSDP and EP over "data" wait in ROADMAP item A7b(ii)."""
