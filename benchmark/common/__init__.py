"""What the cells share: the run, the generators, the counts, the trace,
the import guard."""
