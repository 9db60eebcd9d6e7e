"""The roofline registry: one file a kernel family of the port, which the
harness wraps while the profiled stage runs (`roofline.recording_calls`)
and whose device time it finds by kernel name (`roofline.is_port_kernel`).
A file gives
  MODULE   the module whose attributes the port calls the kernels through;
  CALLS    {attribute: bytes(*args, **kwargs)}: the least bytes one call
           must move, from the call's own arguments;
  KERNELS  the device kernels those calls launch, as the trace names them;
  METRIC   the per-layer metric (`<kernel>_roofline`) whose share it
           enters.
A new kernel's roofline is a new file here and a reader of its METRIC;
no metric reads an entry of another METRIC."""
