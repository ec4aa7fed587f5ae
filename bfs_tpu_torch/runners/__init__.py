"""Command-line entry points: ``run_parallel`` (the engines) and
``run_sequential`` (the host oracle)."""
