"""Host-side helpers of the entry points: the config merge and the plots."""
