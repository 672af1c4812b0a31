"""Device resolution for the port's entry points."""
import torch


def resolve_device(device='cuda'):
    """Return ``torch.device(device)``, refusing CUDA where there is no card.

    A caller that wants the CPU passes ``device='cpu'``; nothing here falls
    back to the CPU silently. Also pins float32 convolutions and matrix
    products to full f32: cuDNN runs f32 convolutions in TF32 by default,
    which keeps about three decimal digits and breaks parity with the JAX
    reference."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {device!r} requested but CUDA is not available; '
                           "pass device='cpu' to run on the CPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev
