"""
The reference of the joint manipulation-classification flow:

    RAW → ISP → [native + manipulations] → 2x2 average pool → channel → FAN

the channel a soft-rounding JPEG at a fixed quality or a learned codec, and
its training step: cross-entropy of the class-major labels, plus λ_nip times
the ISP's L2 loss on the 255 scale when the ISP trains, plus λ_dcn times the
codec's 0.5·Σ(c - C)² + entropy_weight·H when the codec trains; one Adam step
of every trainable leaf. Built from a configuration file's ``flow`` and
``codec`` sections and from leaves that the benchmark hands it. The ISP and
any manipulation outside the four of ``manipulations`` are found by name
(``by_name``); the configuration's ``reference`` names this module, whose
``Flow`` and ``parts`` the benchmark takes.
"""
import torch
import torch.nn.functional as F

from benchmark.reference import by_name, dcn, jpeg, manipulations
from benchmark.reference import fan as fan_ref
from benchmark.reference import ops


def parts(config):
    """{part: (its reference module, the arguments of its ``leaf_shapes``)}
    of the flow's parts that hold leaves: 'nip', 'fan' and, with a learned
    codec, 'dcn'. Every file the configuration names is found here, the
    manipulations' too, so that a missing one fails at set-up."""
    flow = config['flow']
    for spec in flow['manipulations']:
        manipulations.function(spec.split(':')[0])
    out = {'nip': (by_name.isp(flow['nip']), flow.get('nip_args', {})),
           'fan': (fan_ref, {'n_classes': len(flow['manipulations']) + 1, **flow['fan_args']})}
    if flow['distribution']['compression'] == 'dcn':
        out['dcn'] = (dcn, config.get('codec', {}))
    return out


class JointFlow:

    def __init__(self, config, leaves, fault=None):
        """``leaves``: {'<part>/<name>': tensor} for the parts 'nip', 'fan'
        and, with a learned codec, 'dcn'. They are copied. ``fault`` plants
        one (for the readings only): 'half_batch' takes each training step on
        the first half of its rows, 'answer' turns the first row's
        probabilities round by one class where the FAN produces them."""
        self.flow = config['flow']
        self.isp = parts(config)['nip'][0]
        self.codec_args = config.get('codec', {})
        self.training = config.get('training', {})
        self.leaves = {k: v.detach().clone() for k, v in leaves.items()}
        self.trainable = {'fan', *self.flow.get('trainable', ())}
        self.fault = fault
        self.codes = []

    def part(self, name):
        prefix = name + '/'
        return {k[len(prefix):]: v for k, v in self.leaves.items() if k.startswith(prefix)}

    def forward(self, x, index=None):
        """NCHW input (what the ISP takes: a Bayer stack, or RGB) → {'Y' the
        developed RGB, 'c' the expanded and pooled batch, 'C' the channel's
        output, 'probs', and with a learned codec 'entropy', 'q' the quantized
        latent, 'index' its codeword indices, 'code_gap'}. ``index``: the
        codewords a judged program chose, taken in place of the reference's
        own (``dcn.quantize``)."""
        out = {}
        out['Y'] = self.isp.develop(x, self.part('nip'), **self.flow.get('nip_args', {}))
        c = manipulations.expand(out['Y'], self.flow['manipulations'])
        distribution = self.flow['distribution']
        if distribution['downsampling'].startswith('pool'):
            c = F.avg_pool2d(c, 2)
        out['c'] = c
        if distribution['compression'] == 'jpeg':
            out['C'] = jpeg.jpeg(c, distribution['compression_params']['quality'])[0]
        else:
            out['C'], out['entropy'], out['q'], out['index'], out['code_gap'] = dcn.codec(
                c, self.part('dcn'), self.codec_args['latent_bpf'], self.codec_args['v'],
                self.codec_args['gamma'], index)
        out['probs'] = fan_ref.fan(out['C'], self.part('fan'), **self.flow['fan_args'])
        if self.fault == 'answer':
            out['probs'] = torch.cat([out['probs'][:1].roll(1, dims=1), out['probs'][1:]])
        return out

    def losses(self, x, y, index=None):
        """(loss, {'ce', 'nip', 'dcn'}) of NCHW input ``x`` and target RGB ``y``
        (or None); with a learned codec the step's codeword indices and code
        gap are kept in ``self.codes``."""
        out = self.forward(x, index)
        if 'index' in out:
            self.codes.append((out['index'].detach(), out['code_gap']))
        n_classes = len(self.flow['manipulations']) + 1
        labels = torch.arange(n_classes, device=x.device).repeat_interleave(x.shape[0])
        parts = {'ce': fan_ref.cross_entropy(out['probs'], labels)}
        parts['nip'] = (torch.mean((255.0 * y - 255.0 * out['Y']) ** 2) if y is not None
                        else torch.zeros((), device=x.device))
        if 'entropy' in out:
            parts['dcn'] = (0.5 * torch.sum((out['c'] - out['C']) ** 2)
                            + self.codec_args['entropy_weight'] * out['entropy'])
        else:
            parts['dcn'] = torch.mean((out['c'] - out['C']) ** 2)
        loss = parts['ce']
        if 'nip' in self.trainable:
            loss = loss + self.training['lambda_nip'] * parts['nip']
        if 'dcn' in self.trainable:
            loss = loss + self.training['lambda_dcn'] * parts['dcn']
        return loss, parts

    def train(self, batches, codes=None):
        """Adam steps on ``batches`` [(x, y or None)], one a batch: ([{'loss',
        'ce', 'nip', 'dcn'} a step], the first step's gradient {leaf: tensor},
        the leaves after the last step). ``codes``: a judged program's
        codeword indices a step, taken in place of the reference's own."""
        names = [k for k in self.leaves if k.split('/')[0] in self.trainable]
        for k in names:
            self.leaves[k].requires_grad_(True)
        adam = ops.Adam({k: self.leaves[k] for k in names}, self.training['learning_rate'])
        losses, first = [], None
        for step, (x, y) in enumerate(batches):
            if self.fault == 'half_batch':
                x, y = x[:x.shape[0] // 2], None if y is None else y[:y.shape[0] // 2]
            loss, parts = self.losses(x, y, None if codes is None else codes[step])
            grads = torch.autograd.grad(loss, [self.leaves[k] for k in names])
            grads = dict(zip(names, grads))
            if first is None:
                first = {k: g.detach().clone() for k, g in grads.items()}
            adam.step(grads)
            losses.append({'loss': float(loss.detach()),
                           **{k: float(v.detach()) for k, v in parts.items()}})
        return losses, first, {k: self.leaves[k].detach().clone() for k in names}


# the name the benchmark takes a reference flow by (``by_name.flow``)
Flow = JointFlow
