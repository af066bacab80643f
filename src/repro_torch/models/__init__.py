"""The decoder model the agents train: layers → attention → blocks → model."""
