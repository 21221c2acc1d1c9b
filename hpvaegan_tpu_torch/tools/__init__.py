"""Command-line tools of the port that run once, before training."""
