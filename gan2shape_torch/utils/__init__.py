"""Host-side helpers of the entry points (the config merge, the plots) and
the precision policy."""
