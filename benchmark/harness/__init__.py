"""What every cell shares: the manifest, seeded inputs, the trace reader."""
