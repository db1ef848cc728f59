"""Scene helpers of the port's demos (numpy only)."""
