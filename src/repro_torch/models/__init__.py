"""Model families of the port: the dense decoder-only LMs (``lm``) and
RWKV6 (``rwkv``); :func:`repro_torch.models.common.get_family` names what
is not ported yet."""
