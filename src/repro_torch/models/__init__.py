"""The decoder model the agents train: layers → attention / moe / ssm →
blocks → model."""
