"""Wire contract between the per-rank runtimes and the aggregator."""
