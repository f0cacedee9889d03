"""Frozen perception models: the DINOv2-family ViT and its weight loaders."""
