"""The harness: cell lookup, traffic, weights, spans, trace reading and the
comparison that decides ``correct``."""
