"""Host-side mesh helpers of the port (numpy only)."""
