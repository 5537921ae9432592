"""Serve the paper's CNNs -- AlexNet/VGG16/VGG19 -- through the port's engine.

The port of ``examples/serve_cnn.py``: a thin front end to
:func:`repro_torch.launch.serve.main` with the same default arguments;
flags given on the command line (``--device cpu``, ``--reduced``, ...) are
added after them and win over them.

  * ``get_config("alexnet")`` (or ``vgg16`` / ``vgg19``) resolves the CNN
    from the port's registry; without ``--reduced`` it is served at full
    width, on the GPU unless ``--device cpu``.
  * Under an integer KOM policy the engine quantizes every conv/FC weight
    once at build; each serving step quantizes activations only, so a
    request's logits never depend on its batch-mates.
  * A stream of image requests drains through fixed batch buckets (here
    1/4/8), each microbatch zero-padded to a bucket shape; the last line
    reports images/s, latency, padding, expired and failed requests.
  * ``--slo``/``--deadline-ms``, ``--retries`` and ``--fault-plan`` serve
    under deadlines and injected faults; ``--arch alexnet,vgg16`` serves
    both models on one card through the multi-model dispatcher.

Run:  python -m repro_torch.examples.serve_cnn
      python -m repro_torch.examples.serve_cnn --reduced --device cpu
      python -m repro_torch.examples.serve_cnn --arch vgg16 \\
          --policy kom_int14 --explore --model-only --requant
      python -m repro_torch.examples.serve_cnn --arch alexnet,vgg16 \\
          --requests 8 --slo standard --fault-plan transient=0.2,poison=0.05
"""
import sys

from repro_torch.launch.serve import main

DEFAULT_ARGV = ["--arch", "alexnet", "--policy", "kom_int14",
                "--requests", "10", "--buckets", "1,4,8"]

if __name__ == "__main__":
    sys.exit(main(DEFAULT_ARGV + sys.argv[1:]))
