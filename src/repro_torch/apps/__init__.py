"""The paper's three case studies on the port: GF(2) BMVM (``bmvm``), LDPC
min-sum decoding (``ldpc``) and particle-filter tracking
(``particle_filter``)."""


def reject_later_options(pods=None, serdes_cfg=None, tracer=None) -> None:
    """The apps' partitioned-execution and telemetry arguments belong to later
    slices of the port; they raise instead of being ignored."""
    if pods is not None or serdes_cfg is not None:
        raise NotImplementedError("partitioned execution (pods=, serdes_cfg=) is "
                                  "not ported yet (ROADMAP Queue 1 item 7)")
    if tracer is not None:
        raise NotImplementedError("telemetry (tracer=) is not ported yet "
                                  "(ROADMAP Queue 1 item 10)")
