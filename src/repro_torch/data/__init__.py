from repro_torch.data.synthetic import SyntheticLM, batch_shardings
