"""
The numbers that decide ``correct``: what the timed path produced, held
against the plain reference (``reference/``) run on the same inputs and
weights. Each number has a limit in the cell's workload file; a run is
correct when every number is within its limit and no call failed.

Training cells (the first three steps of the object the window drives):
- ``loss_gap``: the largest relative gap of a step's loss or loss part;
- ``grad_gap``: the first step's gradient of each leaf, as the optimizer
  got it (its first moment after one step over 1 - β1), by its norm: the
  largest |‖g‖ - ‖g_ref‖| over max(‖g_ref‖, the median leaf's ‖g_ref‖);
- ``change_gap``: each leaf's change over the three steps, the same way;
  leaves whose reference gradient is under a thousandth of the median
  leaf's move by round-off alone and are left out; ``change_gap_median``:
  the median leaf's gap, not the worst (1 where no leaf moved);
- with a learned codec, ``code_gap``: the reference takes the codewords the
  program chose, and this is the widest distance, in codebook units, by
  which one lies farther from the reference's latent value than its nearest
  codeword, over the three steps, or by which a quantized value lies off
  the codeword it stands for (``flips``: how many a step are not the
  nearest).

Classification cells (a sample of the window's requests, drawn from the seed):
- ``isp_gap``: mean |ΔY| / mean |Y_ref| of the developed RGB;
- ``channel_gap``: the same of the channel's output (the FAN's input), which
  carries the manipulations, the pooling and the channel;
- ``latent_flip_share``: the share of the learned codec's quantized latent
  values on another codeword than the reference's;
- ``prob_gap``: mean |Δp| of the FAN's probabilities.
"""
import numpy as np
import torch

MIN_GRADIENT_SHARE = 1e-3


def _norms(leaves):
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def _gaps(norms, norms_ref, keys):
    """{leaf: the gap of its norm, against its reference norm or the median leaf's}."""
    scale = float(np.median([norms_ref[k] for k in keys]))
    return {k: abs(norms[k] - norms_ref[k]) / max(norms_ref[k], scale, 1e-30) for k in keys}


def _worst(norms, norms_ref, keys):
    """(the largest gap of a leaf's norm, that leaf)."""
    gaps = _gaps(norms, norms_ref, keys)
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def training_numbers(prog, ref):
    """``prog``/``ref``: {'losses': [{'loss', 'ce', 'nip', 'dcn'}] a step,
    'first_grad': {leaf: tensor}, 'start': {leaf: tensor}, 'after': {leaf:
    tensor}} → {'loss_gap', 'grad_gap', 'change_gap'}, the leaves that
    set the last two, and the leaves left out."""
    gaps = [abs(p[k] - r[k]) / abs(r[k]) for p, r in zip(prog['losses'], ref['losses'])
            for k in r if r[k] != 0]
    keys = sorted(ref['first_grad'])
    g, g_ref = _norms(prog['first_grad']), _norms(ref['first_grad'])
    median_g = float(np.median([g_ref[k] for k in keys]))
    moving = [k for k in keys if g_ref[k] >= MIN_GRADIENT_SHARE * median_g]
    change = _norms({k: prog['after'][k].double() - prog['start'][k].double() for k in moving})
    change_ref = _norms({k: ref['after'][k].double() - ref['start'][k].double() for k in moving})
    grad_gap, grad_leaf = _worst(g, g_ref, keys)
    change_gap, change_leaf = _worst(change, change_ref, moving)
    change_median = float(np.median(list(_gaps(change, change_ref, moving).values())))
    out = {'loss_gap': max(gaps), 'grad_gap': grad_gap, 'change_gap': change_gap,
           'change_gap_median': change_median,
           'grad_worst': grad_leaf, 'change_worst': change_leaf,
           'leaves_left_out': sorted(set(keys) - set(moving))}
    if ref.get('code_gaps'):
        out['code_gap'] = max([g for g, _ in ref['code_gaps']] + [prog.get('off_code', 0.0)])
        out['flips'] = [n for _, n in ref['code_gaps']]
        out['code_gaps'] = [g for g, _ in ref['code_gaps']]
    return out


def _relative_mean_gap(a, b):
    if a.shape != b.shape:
        return float('inf')
    return float((a.double() - b.double()).abs().mean() / b.double().abs().mean())


def _cat(outputs, key):
    """The outputs' ``key`` rows, flattened; an empty tensor where one lacks it."""
    if any(key not in o for o in outputs):
        return torch.empty(0)
    return torch.cat([o[key].reshape(o[key].shape[0], -1) for o in outputs])


def classify_numbers(prog, ref):
    """``prog``/``ref``: lists, one a sampled request, of {'Y', 'C', 'probs'
    and with a learned codec 'q'} (NCHW tensors) → the numbers above (the
    ISP's only where it computes, the latent's only with a codec)."""
    if not prog or len(prog) != len(ref):
        return {}
    out = {}
    if 'Y' in ref[0]:
        out['isp_gap'] = _relative_mean_gap(_cat(prog, 'Y'), _cat(ref, 'Y'))
    out['channel_gap'] = _relative_mean_gap(_cat(prog, 'C'), _cat(ref, 'C'))
    if 'q' in ref[0]:
        q, q_ref = _cat(prog, 'q'), _cat(ref, 'q')
        out['latent_flip_share'] = (float(((q - q_ref).abs() > 0.5).double().mean())
                                    if q.shape == q_ref.shape else float('inf'))
    p, p_ref = _cat(prog, 'probs'), _cat(ref, 'probs')
    out['prob_gap'] = (float((p.double() - p_ref.double()).abs().mean())
                       if p.shape == p_ref.shape else float('inf'))
    return out


def verdict(numbers, limits):
    """{name: {'value', 'limit'}} of every number that has a limit, and
    whether each is within it (a value that is not a number never is)."""
    checks = {k: {'value': numbers[k], 'limit': limits[k]} for k in limits if k in numbers}
    missing = sorted(set(limits) - set(numbers))
    ok = not missing and all(np.isfinite(c['value']) and c['value'] <= c['limit']
                             for c in checks.values())
    return checks, ok, missing
