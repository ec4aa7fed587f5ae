"""Measurement scripts of the port's kernels, run on a machine with a card,
and ``ledger_compare``, which diffs two phase ledgers anywhere."""
