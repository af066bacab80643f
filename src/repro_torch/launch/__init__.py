"""Launch: serving on one card (training, mesh and sharding wait in
ROADMAP queue A)."""
