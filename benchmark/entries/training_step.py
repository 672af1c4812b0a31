"""
Entry: ``ManipulationClassification.training_step`` with the deferred NaN
check (one ``assert_finite`` when the window closes), on device-resident
batches cycled from the traffic's pool, at the configuration's λs and
learning rate.

Set-up builds the flow once, takes its first three steps through this same
call on pool batches 0-2 (keeping each step's loss and parts, the first
step's gradient as Adam's first moment holds it, and the leaves before and
after), then warms up; the window goes on with the same object. After the
window the reference takes the same three steps from the same weights.

With a learned codec, a hook that the benchmark puts on the codec's decoder
keeps the quantized latent of each checked step: the codewords the program
chose. The reference takes them in place of its own choice, as a served
model's reference reads the served tokens, and the judgement holds each to
the reference's own latent (``code_gap``): a latent value within round-off
of the midpoint of two codewords goes either way, and one such value taken
the other way moves a step's loss and gradient by more than the rest of the
round-off does.
"""
import time

import torch

from benchmark import generator, judge, system
from benchmark.reference import by_name
from benchmark.reference import dcn as dcn_ref

CHECKED_STEPS = 3


class State:
    pass


def reference_leaves(config, handed, device):
    """The reference's starting leaves: the leaves drawn and handed to the
    program, and the snapshots the configuration names, read here by each
    part's reference (``system.snapshot_leaves``)."""
    return {**handed, **system.snapshot_leaves(config, device)}


def reference(config, handed, device, fault=None):
    """The configuration's reference flow (the ``Flow`` of
    ``reference/<config['reference']>.py``) on its starting leaves."""
    return by_name.flow(config).Flow(config, reference_leaves(config, handed, device), fault)


def setup(config, workload, seed, device, tamper=None):
    s = State()
    s.config, s.workload, s.device = config, workload, device
    t = [time.perf_counter()]
    s.flow, s.handed = system.build(config, seed, device)
    t.append(time.perf_counter())
    s.pool = generator.make_pool(workload['traffic'], seed, device)
    t.append(time.perf_counter())
    s.samples = workload['traffic']['batch']
    s.next = 0
    train = config['training']
    s.args = (train['lambda_nip'], train['lambda_dcn'])
    s.lr = train['learning_rate']
    if tamper is not None:
        tamper(s.flow)
    parts = {'fan', *config['flow'].get('trainable', ())}
    params = system.leaves_of(s.flow, parts)
    s.start = {k: p.detach().clone() for k, p in params.items()}
    s.losses = []
    latents = []
    hook = None
    if config['flow']['distribution']['compression'] == 'dcn':
        hook = system.module_at(s.flow, 'codec.module.decoder').register_forward_pre_hook(
            lambda m, args: latents.append(args[0].detach().clone()))
    for step in range(CHECKED_STEPS):
        s.losses.append(call(s))
        if step == 0:
            state = s.flow.optimizer.state
            s.first_grad = {k: (state[p]['exp_avg'] / 0.1).clone() if p in state
                            else torch.zeros_like(p) for k, p in params.items()}
    s.after = {k: p.detach().clone() for k, p in params.items()}
    if hook is not None:
        hook.remove()
        if len(latents) != CHECKED_STEPS:
            raise RuntimeError(f'{len(latents)} decoder calls in {CHECKED_STEPS} checked steps')
        s.codes, s.off_code = codes_of(latents, config['codec']['latent_bpf'])
    t.append(time.perf_counter())
    for _ in range(workload['warmup_calls']):
        call(s)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    t.append(time.perf_counter())
    s.phases = dict(zip(('build', 'inputs', 'checked_steps', 'warmup'),
                        (b - a for a, b in zip(t, t[1:]))))
    return s


def codes_of(latents, bits):
    """([codeword indices a step], the widest distance of a quantized value
    from the codeword it stands for) of the quantized latents the decoder
    took (the codebook: ``reference.dcn.codebook``)."""
    low = float(dcn_ref.codebook(bits)[0])
    codes = [torch.round(q - low).clamp(0, 2 ** bits - 1).long() for q in latents]
    off = max(float((q - low - c).abs().max()) for q, c in zip(latents, codes))
    return codes, off


def call(s):
    x, y = s.pool[s.next % len(s.pool)]
    s.next += 1
    return s.flow.training_step(x, y, *s.args, learning_rate=s.lr)


def close(s):
    """Failed calls: all of them where a step's gradient was not finite."""
    try:
        s.flow.assert_finite()
    except RuntimeError:
        return None
    return 0


def program_side(s):
    """What the three checked steps gave, as plain values and tensors."""
    losses = [{'loss': float(loss), **{k: float(v) for k, v in parts.items()}}
              for loss, parts in s.losses]
    return {'losses': losses, 'first_grad': s.first_grad, 'start': s.start, 'after': s.after,
            'off_code': getattr(s, 'off_code', 0.0)}


def reference_side(s, fault=None):
    """The reference's three steps from the same weights on the same batches
    (``fault``: see the reference flow's ``Flow``), on the codewords
    ``s.codes`` where the program's were kept (else its own), with each
    step's codewords and code gap."""
    ref = reference(s.config, s.handed, s.device, fault)
    start = {k: ref.leaves[k].clone() for k in s.start}
    batches = [(generator.nchw(x, s.device), None if y is None else generator.nchw(y, s.device))
               for x, y in s.pool[:CHECKED_STEPS]]
    losses, first, after = ref.train(batches, getattr(s, 'codes', None))
    return {'losses': losses, 'first_grad': first, 'start': start, 'after': after,
            'codes': [c for c, _ in ref.codes], 'code_gaps': [g for _, g in ref.codes]}


def free(s):
    """Drop the program's state, keeping what the judgement needs."""
    s.flow = None


def numbers(prog, ref):
    return judge.training_numbers(prog, ref)


def reference_call(s):
    """One reference call at the cell's shapes, for the FLOP count: the loss
    of a batch and its gradient."""
    ref = reference(s.config, s.handed, s.device)
    x, y = s.pool[0]
    names = [k for k in ref.leaves if k.split('/')[0] in ref.trainable]
    for k in names:
        ref.leaves[k].requires_grad_(True)
    loss, _ = ref.losses(generator.nchw(x, s.device),
                         None if y is None else generator.nchw(y, s.device))
    torch.autograd.grad(loss, [ref.leaves[k] for k in names])
