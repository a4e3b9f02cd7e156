"""Slot-stacked LoRA and the serving steps."""
