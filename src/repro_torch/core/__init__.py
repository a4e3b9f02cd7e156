"""The LoRA core, the train and eval steps, the executor, the engine of
paper Listing 1 and the tuning service."""
