"""Host-side helpers of the serving path."""
