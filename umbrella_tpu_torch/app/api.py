"""API demo, the counterpart of the JAX package's `app/api.py`: a server on
this process's engine and a client that sends it one chat request.

    python -m umbrella_tpu_torch.app.api --configuration configs/chat_config_8b_v5e.json
"""
from ..api.client import APIClient
from ..api.server import APIServer
from ..templates import Prompts, SysPrompts
from . import load_config, parse_args


def main(argv=None, config=None):
    """`config` (a dict) stands in for the file's; returns the client's result."""
    args = parse_args(argv, port=(int, 65432), max_new_tokens=(int, 128))
    if config is None:
        config, template, _, _ = load_config(args.configuration)
    else:
        config = dict(config)
        template = config.pop("template", "meta-llama3")
    server = APIServer(config, device=args.device, port=args.port)
    server.start()
    try:
        client = APIClient(port=server.port)
        client.run()
        context = SysPrompts[template] + Prompts[template].format(
            "Tell me about speculative decoding.")
        output = client.get_output(context=context, max_new_tokens=args.max_new_tokens)
        print(output["generated_text"])
        print("avg_accept_tokens:", output["avg_accept_tokens"],
              "| time_per_output_token:", output["time_per_output_token"], "ms")
        client.close()
    finally:
        server.shutdown()
    return output


if __name__ == "__main__":
    main()
