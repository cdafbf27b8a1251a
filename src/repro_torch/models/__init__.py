from repro_torch.models.zoo import Model, build_model
