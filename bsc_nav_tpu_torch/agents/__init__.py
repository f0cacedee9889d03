"""Host-side agents: the spatial-memory agent over the ported pipelines,
the robots (objnav, localize, EQA), the LLM layer and the numpy
clustering of query candidates."""
