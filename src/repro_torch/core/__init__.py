"""Paper core of the port: mixing matrices, gossip, D-PSGD, priced training."""
