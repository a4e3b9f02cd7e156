"""Scheduling pieces the serving tier needs (the memory model)."""
