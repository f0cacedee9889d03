"""Host-side agents: the spatial-memory agent over the ported pipelines."""
