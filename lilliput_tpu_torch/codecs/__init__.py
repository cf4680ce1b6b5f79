"""Host codec helpers of the port."""
