"""Which linear-algebra calls of the loop correction capture into a CUDA
graph on this card, under each of PyTorch's linear-algebra backends: a
batched 3x3 determinant at the map's 20480 landmarks
(``ba.retriangulate_points``), a 768x768 ``solve_ex`` (PGO's dense system at
128 keyframes), a stable sort and a ``searchsorted`` (the fixed-order sums'
plans). Each call runs once eagerly, once on a side stream, then is
captured and replayed and compared with the eager result; prints a line a
call and backend.

    python3 tools/linalg_capture_probe.py
"""

import sys

import torch


def main():
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    print("backend", torch.backends.cuda.preferred_linalg_library(), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    A3 = torch.randn(20480, 3, 3, generator=g).to(dev)
    A768 = torch.randn(768, 768, generator=g).to(dev)
    A768 = A768 @ A768.T + 768 * torch.eye(768, device=dev)
    b768 = torch.randn(768, generator=g).to(dev)
    cases = {
        "det_20480x3x3": lambda: torch.linalg.det(A3),
        "solve_ex_768": lambda: torch.linalg.solve_ex(A768, b768)[0],
        "sort_stable": lambda: torch.sort(A3.reshape(-1), stable=True)[0],
        "searchsorted": lambda: torch.searchsorted(torch.sort(A3.reshape(-1))[0],
                                                   torch.linspace(-3, 3, 100, device=dev)),
    }
    for lib in ("default", "cusolver", "magma"):
        try:
            torch.backends.cuda.preferred_linalg_library(lib)
        except RuntimeError as e:
            print(lib, "cannot set", e)
            continue
        for name, fn in cases.items():
            if lib != "default" and not name.startswith(("det", "solve")):
                continue
            try:
                want = fn()
                torch.cuda.synchronize()
                s = torch.cuda.Stream()
                s.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(s):
                    fn()
                torch.cuda.current_stream().wait_stream(s)
                torch.cuda.synchronize()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                    out = fn()
                graph.replay()
                torch.cuda.synchronize()
                print(lib, name, "captured", "equal" if torch.equal(out, want) else "DIFFERS",
                      flush=True)
            except RuntimeError as e:          # a capture the backend breaks
                print(lib, name, "FAILED", type(e).__name__, str(e).splitlines()[0][:200],
                      flush=True)
                torch.cuda.synchronize()
    torch.backends.cuda.preferred_linalg_library("default")


if __name__ == "__main__":
    main()
