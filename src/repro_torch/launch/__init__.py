"""Entry points: step builders and the serving driver."""
