from qpsk_tpu_torch.utils.checkpoint import load_state, save_state
