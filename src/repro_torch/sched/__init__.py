"""The host-side scheduler: the inter-task planner, the elastic cluster
runtime, the intra-task admission policy, the profiler and its fitted cost
models, the event vocabulary, the write-ahead journal and the chaos
harness."""
