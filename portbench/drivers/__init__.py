"""One module a kind of traffic, named by a mix's ``driver`` key; each
exposes ``run(ctx) -> Outcome``."""
