"""The port's benchmark (`run.py` says how to run and extend it)."""
