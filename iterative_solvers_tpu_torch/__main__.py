from iterative_solvers_tpu_torch.cli import main

raise SystemExit(main())
