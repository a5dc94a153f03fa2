"""Many sequences and many processes (port of `parallel/`): the sequence
fleet and segment runners (`mesh`, `segments`), the edge-sharded pose-graph
optimizer (`pgo`), process-group bring-up and job sharding
(`distributed`), and the parameter-sweep harness (`sweep`)."""
