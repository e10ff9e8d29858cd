"""The synthetic token pipeline of the language models' training."""
