from .complexpair import complex_to_pair, from_pair_np, pair_to_complex, to_pair

__all__ = ["complex_to_pair", "from_pair_np", "pair_to_complex", "to_pair"]
