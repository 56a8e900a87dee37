from repro_torch.data.synthetic import ByteCorpus, SyntheticTokens

__all__ = ["ByteCorpus", "SyntheticTokens"]
