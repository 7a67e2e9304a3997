"""Distribution: the logical-axis sharding policy (``sharding``) and the
dry run's reading of a trace of dispatched ops (``trace_analysis``)."""
