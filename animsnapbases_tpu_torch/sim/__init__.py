"""Host model, solver glue and the reduced solver of the port."""
