"""Run-directory utilities: metric logging, checkpoints, config composition."""
