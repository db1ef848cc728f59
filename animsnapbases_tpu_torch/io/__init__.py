"""Binary and mesh file formats of the port (numpy only)."""
