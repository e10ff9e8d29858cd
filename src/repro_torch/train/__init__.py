"""Serving (and, in a later slice, training) steps of the language models."""
