"""Command-line entry points of the port's language models, and the shape
cells (``shapes``) they and the cluster autotuner are sized by."""
