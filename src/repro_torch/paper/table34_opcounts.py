"""Tables 3 & 4: rotation op counts (exact reproduction: these are
arithmetic identities, so the numbers match the paper digit for digit).

    PYTHONPATH=src python -m repro_torch.paper.table34_opcounts
"""
from ..core import hadamard as hd

T3 = [("llama3-1b/3b", 8192), ("llama3-8b", 14336), ("qwen3-1.7b", 6144),
      ("qwen3-4b", 9728), ("qwen3-8b", 12288)]
T4 = [("llama3-8b", 14336), ("qwen3-0.6b", 3072), ("qwen3-1.7b", 6144),
      ("qwen3-4b", 9728), ("qwen3-8b", 12288)]


def main(argv=None):
    print("# Table 3: block vs full-vector rotation ops")
    print("model,d,b32,b128,b512,full")
    for name, d in T3:
        print(f"{name},{d},{hd.ops_block(d,32)},{hd.ops_block(d,128)},"
              f"{hd.ops_block(d,512)},{hd.ops_full_vector(d)}")
    print("# Table 4: non-pow2 full rotation methods")
    print("model,d,matmul,butterfly_matmul,ours")
    for name, d in T4:
        print(f"{name},{d},{hd.ops_dense_matmul(d)},"
              f"{hd.ops_butterfly_matmul(d)},{hd.ops_optimized(d)}")


if __name__ == "__main__":
    main()
