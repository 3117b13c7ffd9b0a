"""The yardstick's counts: the device's published peaks, the model FLOPs
of a scheduler step worked out from shapes, and each hand-written
kernel's least time (its bytes over the memory rate against its
operations over the peak rate of their type, the larger).  Frozen here so
that no later change to the program moves a bound; nothing here imports
the program."""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12          # fp32 outside the tensor cores
INT32_LANES_PER_SM = 64     # INT32 operations per SM and clock (Hopper white paper)
# integer-ALU instructions per Threefry-2x32 call of the keyed secure-mask
# kernel: 20 funnel-shift rotates, 20 xors and the >> 8 of its two outputs
# (its adds issue on the FMA pipe and are left out)
THREEFRY_INT_OPS = 20 + 20 + 2


def bound_ms(nbytes: float, ops: float, rate: float = FP32_FLOPS) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / rate) * 1e3


# ---------------------------------------------------------------------------
# model FLOPs
# ---------------------------------------------------------------------------

def gnlenet_macs(m: dict) -> int:
    """Multiply-adds of one image's forward pass: two 'same' k x k
    convolutions (the second after a 2x2 pool), then fc and the
    classifier after a second pool; GroupNorm, ReLU and pooling left
    out."""
    k, h, c0, c1 = m["kernel"], m["image"], m["channels"], m["width"]
    c2 = 2 * c1
    conv1 = h * h * c1 * k * k * c0
    conv2 = (h // 2) ** 2 * c2 * k * k * c1
    flat = c2 * (h // 4) ** 2
    return conv1 + conv2 + flat * m["fc_hidden"] + m["fc_hidden"] * m["classes"]


def gnlenet_chunk_flops(m: dict, n_nodes: int, local_steps: int, batch: int, rounds: int,
                        evals: int, n_test: int, active: float = 1.0) -> float:
    """Model FLOPs of ``rounds`` rounds and ``evals`` evaluations: 3 x the
    forward (forward and the two backward products) of every sample the
    active nodes trained on, plus every node's forward over the test
    images."""
    fwd = 2 * gnlenet_macs(m)
    train = 3 * fwd * active * n_nodes * local_steps * batch * rounds
    return train + fwd * n_nodes * n_test * evals


def lm_params(m: dict) -> int:
    """Parameters of a Llama-style decoder with tied embeddings."""
    d, L, ff, v = m["hidden_size"], m["num_hidden_layers"], m["intermediate_size"], m["vocab_size"]
    hd = d // m["num_attention_heads"]
    q, kv = m["num_attention_heads"] * hd, m["num_key_value_heads"] * hd
    layer = 2 * d + d * q + 2 * d * kv + q * d + 3 * d * ff
    return v * d + d + L * layer


def lm_step_flops(m: dict, n_nodes: int, batch: int, seq: int) -> float:
    """Model FLOPs of one trainer step: 3 x (2 x parameters per token, the
    tied head counted once and the embedding lookup not at all, plus
    causal attention's two products over (seq + 1) / 2 keys on average)
    over every node's tokens."""
    d, L = m["hidden_size"], m["num_hidden_layers"]
    attn = L * 2 * 2 * d * (seq + 1) / 2
    return 3 * (2 * lm_params(m) + attn) * n_nodes * batch * seq


# ---------------------------------------------------------------------------
# kernel bounds (ms)
# ---------------------------------------------------------------------------

def merge_bound_ms(n: int, k: int, p: int, item: int, x_rows: int) -> float:
    """out[n] = sum_k w[n,k] X[rows[n,k]]: ``x_rows`` rows of X read once,
    the (n, k) index and weight tables read once, out written once,
    against 2·k·n·p fp32 operations."""
    return bound_ms(x_rows * p * item + n * k * 8 + n * p * item, 2 * k * n * p)


def payload_bound_ms(n: int, p: int, r: int, k: int, s: int) -> float:
    """The payload merge: X read and out written once, the (R, k) idx and
    val payloads and the (N, S) tables read once; a subtract, a multiply
    and an add per operand entry."""
    return bound_ms(2 * n * p * 4 + r * k * 8 + n * s * 8, 3 * n * s * k)


def keyed_bound_ms(b: int, m: int, calls: int, int_rate: float) -> float:
    """The keyed secure mask: x's rows read and out written once against
    the integer instructions of its cipher calls, one call per lane and
    nonzero slot."""
    return max(2 * b * m * 4 / HBM_BYTES_PER_S, calls * THREEFRY_INT_OPS / int_rate) * 1e3


def int32_rate(sms: int, max_sm_mhz: float) -> float:
    """INT32 operations per second: 64 lanes per SM and clock at the card's
    SM count and maximum SM clock."""
    return INT32_LANES_PER_SM * sms * max_sm_mhz * 1e6
