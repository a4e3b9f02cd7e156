"""Model: common ops, RoPE, attention, blocks, the stacked decoder."""
