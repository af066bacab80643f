"""Launch on one card: the D-PSGD training step (``train``) over a mesh
description (``mesh``) and a fabric's designed W (``fabric``), and serving
(``serve``). Sharding over several cards waits in ROADMAP queue A."""
