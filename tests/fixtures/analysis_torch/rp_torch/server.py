"""Fixture: torch's global generator reachable from the serving
entrypoints, outside the determinism scopes."""
from helpers import sample


class OptimizerServer:
    def serve(self, n):
        return sample(n)
