"""The optimizer itself: performance models, MOO solvers, tuning."""
