"""Host time of one decode step, from the call of ``transformer.decode_step``
to its return (before ``serve_batch``'s synchronise), averaged over every
step of the measured window; a program span taken by the harness's wrapper.
Nothing to read without decode steps."""


def read(r):
    if not r.decode_host_s:
        return None
    return 1e3 * sum(r.decode_host_s) / len(r.decode_host_s)
