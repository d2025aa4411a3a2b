"""A pure-Python mirror of ``instance_norm_plan`` (``light_unet_tpu_torch/
csrc/instance_norm.cu``): how the fused InstanceNorm + LeakyReLU kernel
cuts each sample into chunks and the grid into groups of co-resident CTAs.

The CPU tests check its properties; a card test holds the C plan equal to
it.  Defaults are an H100's limits (132 SMs, 228 KB of shared memory per
SM, 227 KB per CTA, 1 KB reserved per CTA)."""

THREADS, MAX_THREADS, CTAS_PER_SM_TARGET = 256, 1024, 2
H100 = dict(sms=132, smem_per_sm=233472, smem_per_block=232448, reserved=1024)


def _align16(n):
    return (n + 15) // 16 * 16


def _ceil_div(n, d):
    return -(-n // d)


def norm_plan(elt, b, s, c, *, sms=H100["sms"], smem_per_sm=H100["smem_per_sm"],
              smem_per_block=H100["smem_per_block"], reserved=H100["reserved"],
              ctas_per_sm=None):
    """The plan for ``b`` samples of ``s`` rows of ``c`` channels of
    ``elt``-byte elements: a dict with the C plan's fields.  ``ctas_per_sm``
    (of the variant the plan takes) defaults to what shared memory and threads
    allow; the card's occupancy query also counts registers, which never
    limit the resident variant below the two CTAs per SM its chunks are sized
    for.  Raises ValueError where the C entry fails."""
    v = 16 // elt if (c * elt) % 16 == 0 else 1
    cv = c // v
    threads = THREADS if cv <= THREADS else _ceil_div(cv, 32) * 32
    if threads > MAX_THREADS:
        raise ValueError(f"{c} channels need {threads} threads")
    shuffled = cv < 32 and 32 % cv == 0
    nh = threads // 32 if shuffled else threads // cv
    fixed = nh * cv * 2 * v * 4 + 2 * c * 4  # reduction buffer + coefficients
    row = c * elt

    def smem(rows):
        return _align16(rows * row) + fixed

    k, rpc = 1, s
    if smem(s) > smem_per_block:
        cap = (smem_per_sm // CTAS_PER_SM_TARGET - reserved - fixed) // 16 * 16
        rows_cap = cap // row
        if rows_cap < 1:
            raise ValueError(f"a row of {row} bytes does not fit a chunk")
        k = _ceil_div(s, rows_cap)
        rpc = _ceil_div(s, k)
        k = _ceil_div(s, rpc)

    def resident(nbytes):  # by shared memory and threads; the card's query also counts registers
        return min(smem_per_sm // (nbytes + reserved), 2048 // threads)

    nbytes = smem(rpc)
    stream = k > resident(nbytes) * sms
    if stream:  # the whole grid on one sample at a time, x read twice
        nbytes = fixed
        rpc = _ceil_div(s, (ctas_per_sm or resident(nbytes)) * sms)
        k = _ceil_div(s, rpc)
    ctas_per_sm = ctas_per_sm or resident(nbytes)
    groups = min(b, ctas_per_sm * sms // k)
    if groups < 1:
        raise ValueError(f"{k} chunks of a sample cannot all be resident")
    return dict(k=k, rows_per_chunk=rpc, groups=groups, threads=threads, smem=nbytes,
                ctas_per_sm=ctas_per_sm, sms=sms, streams=int(stream))


def assignments(plan, b, s):
    """(CTA, round, sample, first row, end row) of every chunk the grid takes."""
    k, rpc, g = plan["k"], plan["rows_per_chunk"], plan["groups"]
    out = []
    for cta in range(g * k):
        group, q = divmod(cta, k)
        for rnd, sample in enumerate(range(group, b, g)):
            out.append((cta, rnd, sample, q * rpc, min(s, (q + 1) * rpc)))
    return out
