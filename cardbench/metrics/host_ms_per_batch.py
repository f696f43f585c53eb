"""host_ms_per_batch: the host's part of a compiled batch outside its step,
(sum of serve.batch.* - sum of serve.step.*) over the batches, in ms:
packing and row copies, the host-to-device copy, and decode."""


def read(run):
    c = run.counters
    n = c.get("serve.batch.count", 0.0)
    if n <= 0:
        return None
    return (c["serve.batch.sum_us"] - c["serve.step.sum_us"]) / n / 1e3
