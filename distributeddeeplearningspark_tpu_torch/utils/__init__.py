"""Small helpers of the port."""
