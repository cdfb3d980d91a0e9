from x266_tpu_torch.cli.main import main

raise SystemExit(main())
