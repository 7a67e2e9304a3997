"""Serving path of the port: the paged continuous-batching engine and the
Aladdin cluster control plane over live engine workers."""
