"""Published configurations of the ported architectures, one module each
(``config()`` at full width, ``smoke_config()`` for tests)."""
