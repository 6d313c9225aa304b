"""Layer ops of the PyTorch port: gate, dispatch, ragged plans, expert FFN, MoE layer, attention."""
