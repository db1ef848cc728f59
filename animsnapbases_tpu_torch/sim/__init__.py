"""Host model, the full-order solver, the reduced solver of the port."""
