"""Device-history budget for the lazy facade histories.

The reference appends every step to Python lists on the host
(reference: gibbs.py:28,158-159). The facades here keep their output
history chunks **on the accelerator** until either a host view is
requested (get_sample etc.) or the accumulated device bytes exceed
``DEVICE_HISTORY_LIMIT``, so sampling throughput is decoupled from
history transfer entirely and transfers happen in large consolidated
blocks. Each facade owns its (small) chunk-management logic —
MetropolisChain/_fetch_history, HamiltonianChain/_fetch_history and
EnsembleSampler/_consolidate_history — because their chunk shapes and
deferred side-channels (width traces, epsilon traces, walker statistics)
differ; this module holds the shared budget.
"""

# offload device-held history once it exceeds this many bytes, bounding
# device-memory growth on very long runs (the transfer is one consolidated block);
# tune per deployment: higher = fewer, larger offload stalls
DEVICE_HISTORY_LIMIT = 2**30
