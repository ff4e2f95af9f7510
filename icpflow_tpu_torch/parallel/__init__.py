"""The sharded step over a (dp, cp) mesh of torch.distributed ranks."""
