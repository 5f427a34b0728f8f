"""Edge engine, collection state, errors and cross-request scan batching."""
