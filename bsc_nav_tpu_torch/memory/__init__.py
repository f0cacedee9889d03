"""Voxel token store, batched ingest, query and the fused pipelines."""
