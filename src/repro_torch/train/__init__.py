"""Training and serving steps of the port's language models: the synthetic
data, AdamW with its schedule, the microbatched train step, checkpoints,
the auto-resuming trainer and the serving steps (prefill, decode, greedy
generation)."""
