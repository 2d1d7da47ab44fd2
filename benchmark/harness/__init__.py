"""The benchmark's harness: finding a cell's files (`spec`), the traffic
generator (`traffic`), a run (`drive`), the traced slice (`trace`), the
check against the plain reference (`check`), the work counts of the
roofline bounds (`work`) and the readers' shared arithmetic (`readers`).
It imports `rtw_tpu_torch` (the system under test) and `plainref` (the
benchmark's own plain reference), and nothing of JAX or `rtw_tpu`."""
