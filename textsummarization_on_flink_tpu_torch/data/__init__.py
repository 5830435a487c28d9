"""Data layer of the port: vocab, OOV ids, static-shape batches, the
raw-text and chunk-file sources, and the threaded bucketing batcher."""
