"""
Live process resource tracer: the counterpart of the repository's
``pstrace.py``, with its arguments. It samples a process's CPU share and
resident memory from ``/proc`` to the terminal (with a bar) and, with
``--csv``, appends them to a CSV file. It runs nothing on a device.

    python -m neural_imaging_tpu_torch.cli.pstrace [PID] [--interval 1] [--duration 60] [--csv F]
"""
import argparse
import os
import time


def read_proc(pid):
    """Return (rss_mb, utime+stime jiffies) for a pid."""
    with open(f'/proc/{pid}/stat') as f:
        parts = f.read().split()
    utime, stime = int(parts[13]), int(parts[14])
    rss_pages = int(parts[23])
    return rss_pages * os.sysconf('SC_PAGE_SIZE') / 1024 / 1024, utime + stime


def build_parser():
    parser = argparse.ArgumentParser(description='Live process CPU/RSS tracer (PyTorch port)')
    parser.add_argument('pid', type=int, nargs='?', default=os.getpid())
    parser.add_argument('--interval', type=float, default=1.0)
    parser.add_argument('--duration', type=float, default=60.0)
    parser.add_argument('--csv', default=None, help='append samples to a CSV file')
    return parser


def main(argv=None):
    """Sample until ``--duration`` has passed or the process exits; returns
    the samples as [(time, rss_mb, cpu_pct)]."""
    args = build_parser().parse_args(argv)
    hz = os.sysconf('SC_CLK_TCK')
    csv = open(args.csv, 'a') if args.csv else None
    if csv and csv.tell() == 0:
        csv.write('time,rss_mb,cpu_pct\n')

    samples = []
    last_jiffies = None
    t_end = time.time() + args.duration
    try:
        while time.time() < t_end:
            try:
                rss, jiffies = read_proc(args.pid)
            except (FileNotFoundError, ProcessLookupError):
                print(f'process {args.pid} exited')
                break
            cpu = 0.0
            if last_jiffies is not None:
                cpu = 100.0 * (jiffies - last_jiffies) / hz / args.interval
            last_jiffies = jiffies
            bar = '#' * int(min(cpu, 200) / 4)
            print(f'{time.strftime("%H:%M:%S")} pid={args.pid} '
                  f'rss={rss:8.1f}MB cpu={cpu:6.1f}% {bar}')
            samples.append((time.time(), rss, cpu))
            if csv:
                csv.write(f'{samples[-1][0]},{rss:.1f},{cpu:.1f}\n')
                csv.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    finally:
        if csv:
            csv.close()
    return samples


if __name__ == '__main__':
    main()
